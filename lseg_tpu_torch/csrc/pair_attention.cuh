// The head-pair attention block shared by kernels B2
// (flash_attention_ln_qkv_q8.cu) and B15 (flash_attention_qkvp_fused.cu):
// the attention of two heads (a pair, 128 columns) over the bf16 qkv
// (N, T, 3D), and the int8 quantize of its output.
//
// A block is one (64 query rows, head pair, image). Each of its two
// warpgroups runs the wgmma + TMA interior of flash_flat.cuh (`attend`:
// the Q tile by TMA once, a two-stage K/V TMA ring on mbarriers, SS
// Q.K^T, RS bf16(P).V, ex2.approx of one FMA) for one head of the pair,
// on its own 40 KB of shared memory and its own named barrier. Rounding
// points of the interior as in B6: fp32 scores, the online softmax in
// fp32, P cast to bf16, fp32 sums; O = o / l divided in fp32.
//
// The epilogue quantizes O per row, s = max(amax, 1e-8) / 127 (a true
// IEEE division) and codes round-half-even(O / s) clipped to +-127, in
// one of two modes:
//   - pair (B15): O stays fp32, the amax is over the pair's 128 columns,
//     and one fp32 scale per (row, pair) goes to `scales` (N*T, D / 128);
//   - row (B2): O is rounded to bf16 first, and the amax is over all D
//     columns of the row. The blocks of one (row tile, image) are
//     launched as a thread-block cluster of the D / 128 pairs (at most 8,
//     the portable cluster size: D <= 1024); each CTA takes its slice's
//     row maxima and stores them into every peer's shared memory
//     (st.shared::cluster at mapa addresses, cluster.cuh), crosses a
//     cluster barrier, and takes the maximum of the D / 128 slice maxima:
//     max is exact and order-free, so the row scale equals one taken over
//     the whole row bit for bit. Rank 0 writes the (N*T,) scale.
// Either way each block writes only its pair's 128 code columns, staged
// in shared memory and stored 16 bytes a thread.
//
// QK8 (B2's int8 Q.K^T mode, the TPU kernel's `qk_int8`): each warpgroup
// runs `attend<true>` (flash_flat.cuh), which re-quantizes its head's Q
// tile and each K tile per row in shared memory and takes Q.K^T as s8
// wgmma with int32 sums, the scores dequantized as float(acc) * ((sq *
// scale) * sk); P.V and the epilogue are unchanged. Its row factors and
// key scales take 1 KB (`fac`).
//
// Budgets: 95 KB of shared memory and at most 128 registers a thread, so
// two blocks (four warpgroups) share an SM.

#pragma once

#include "cluster.cuh"
#include "flash_flat.cuh"

namespace lseg {
namespace {
namespace pair_attn {

namespace ff = flash_flat;

constexpr int HD = ff::HD;
constexpr int PW = 2 * HD;   // columns of a head pair
constexpr int BQ = ff::BQ;   // query rows of a block
constexpr int WG_THREADS = 128;
constexpr int THREADS = 2 * WG_THREADS;  // a warpgroup per head
constexpr int MAX_CLUSTER = 8;
constexpr int LDC = PW + 16;  // code stage row stride in bytes

struct Smem {
  ff::Tiles t[2];               // each head's Q tile and K/V ring
  ff::Bars b[2];
  float hmax[2][BQ];            // each head's row maxima
  float amax[MAX_CLUSTER][BQ];  // row mode: each CTA's slice maxima
  uint8_t codes[BQ * LDC];      // the block's (64, 128) codes
  float fac[2][2 * BQ];         // QK8: each head's sq * scale and sk
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack

// The block's work; blockIdx = (pair, row tile, image). ROW selects B2's
// row mode (launched as clusters along x), else B15's pair mode; QK8
// B2's int8 Q.K^T mode.
template <bool ROW, bool QK8 = false>
__device__ __forceinline__ void run(const CUtensorMap& map,
                                    int8_t* __restrict__ aq,
                                    float* __restrict__ scales, int T, int D,
                                    int valid_len, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int pair = blockIdx.x, pairs = gridDim.x;
  const int q0 = blockIdx.y * BQ, img = blockIdx.z;
  const int hh = threadIdx.x / WG_THREADS;  // head of the pair
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int head = 2 * pair + hh;
  const int k_col = D + head * HD, v_col = 2 * D + head * HD;
  const int n_kt = (valid_len + ff::BKV - 1) / ff::BKV;

  // row mode: the first half of a cluster barrier, waited for before the
  // first store into a peer's shared memory
  if constexpr (ROW) cluster::arrive();
  if (tid == 0) ff::init_bars(sm.b[hh]);
  __syncthreads();
  if (tid == 0)
    ff::issue_first(sm.t[hh], sm.b[hh], &map, head * HD, k_col, v_col, q0,
                    img, n_kt);
  float o[8][4], m2[2], l[2];
  if constexpr (QK8)
    ff::attend<true>(sm.t[hh], sm.b[hh], &map, k_col, v_col, img, n_kt,
                     valid_len, 1.4426950408889634f, tid, 1 + hh, o, m2, l,
                     sm.fac[hh], scale);
  else
    ff::attend(sm.t[hh], sm.b[hh], &map, k_col, v_col, img, n_kt,
               valid_len, scale * 1.4426950408889634f, tid, 1 + hh, o, m2,
               l);

  // O = o / l in fp32 (bf16 in row mode), and each row's amax over the
  // head's 64 columns
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};  // of the 64
  float mx[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = __fdiv_rn(o[dt][2 * r + e], l[r]);
        if constexpr (ROW) v = __bfloat162float(__float2bfloat16_rn(v));
        o[dt][2 * r + e] = v;
        mx[r] = fmaxf(mx[r], fabsf(v));
      }
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (t4 == 0) sm.hmax[hh][row[r]] = mx[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(sm.hmax[0][row[r]], sm.hmax[1][row[r]]);

  if constexpr (ROW) {  // the row's amax over the cluster's D / 128 slices
    const int rank = cluster::rank();
    cluster::wait();  // every CTA of the cluster runs
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      const float v = fmaxf(sm.hmax[0][r], sm.hmax[1][r]);
      for (int p = 0; p < pairs; ++p)
        cluster::st_peer(cluster::peer_addr(&sm.amax[rank][r], p), v);
    }
    cluster::sync();  // the slice maxima are exchanged
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = 0.0f;
      for (int p = 0; p < pairs; ++p)
        mx[r] = fmaxf(mx[r], sm.amax[p][row[r]]);
    }
  }

  // codes into the stage, the scales out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sc = __fdiv_rn(fmaxf(mx[r], 1e-8f), 127.0f);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const uint32_t lo = quantize_code(o[dt][2 * r], sc) & 0xffu;
      const uint32_t hi = quantize_code(o[dt][2 * r + 1], sc) & 0xffu;
      *reinterpret_cast<uint16_t*>(sm.codes + row[r] * LDC + hh * HD +
                                   dt * 8 + 2 * t4) =
          static_cast<uint16_t>(lo | (hi << 8));
    }
    const int t = q0 + row[r];
    if (hh == 0 && t4 == 0 && t < T) {
      const long long grow = static_cast<long long>(img) * T + t;
      if constexpr (!ROW)
        scales[grow * pairs + pair] = sc;
      else if (pair == 0)
        scales[grow] = sc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * (PW / 16); i += THREADS) {
    const int r = i / (PW / 16), ch = i % (PW / 16);
    if (q0 + r >= T) break;  // rows grow with i: the rest are past T too
    *reinterpret_cast<uint4*>(
        aq + (static_cast<long long>(img) * T + q0 + r) * D + pair * PW +
        ch * 16) = *reinterpret_cast<const uint4*>(sm.codes + r * LDC +
                                                   ch * 16);
  }
}

}  // namespace pair_attn
}  // namespace
}  // namespace lseg
