// The whole int8 attention half-block for Hopper (sm_90a), kernel B15:
// int8 qkv projection + flash attention + per-(row, head pair) int8
// requantize + int8 output projection + bias + residual.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_qkvp_fused
// (Pallas TPU; body _kernel_qkvp).
//
// Input: the per-row int8 codes xq (N, T, D) of the LayerNorm-1 output and
// their fp32 row scales sx (N, T), the int8 qkv weight (3D, D) and proj
// weight (D, D) (the port's (out, in) storage), their fp32 per-output-
// channel scales and biases, and the bf16 residual stream (N, T, D).
// Output: resid + proj(attn(qkv(x))), (N, T, D) bf16. Keys at or past
// `valid_len` are masked out of the softmax.
//
// Rounding points, in order, as in the TPU kernel:
//   1. acc = xq . wq^T exact in int32, ((acc * sx) * sw) + b in fp32 (no FMA
//      contraction), cast to bf16;
//   2. per head, fp32 scores times `scale`, exp(s - m) in fp32, P cast to
//      bf16 for P.V with fp32 accumulation, divided by the fp32 row sum and
//      kept in fp32 (not rounded to bf16);
//   3. per row and head pair p (128 columns), sa = max(max|o|, 1e-8) / 127
//      and codes round-half-even(o / sa) clipped to +-127;
//   4. part_p = (int32 (aq_p . wp[:, p*128 : (p+1)*128]^T) * sa) * sp in
//      fp32; acc = (part_0 + bp) + resid, then acc += part_p for p = 1 ..
//      P - 1 in that order; cast to bf16.
// One difference, as in B6: the online softmax rounds P relative to the
// running row maximum, where the TPU kernel uses the maximum of the row.
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, 22.7 G int8 MAC of qkv and 7.6 G of proj (60.4 GOP, ~0.031 ms at
// 1979 TOP/s) and 26.6 GFLOP of attention products (~0.027 ms at 989
// TFLOP/s), against ~36 MB of codes, weights, residual and output: the
// operations bound it (~0.057 ms).
//
// Design: the simple form, a chain of three launches on one stream.
//   (a) B2's int8 GEMM with its dequant epilogue (qkv_int8_gemm.cuh) ->
//       bf16 qkv (N*T, 3D);
//   (b) the pair interior: one 256-thread block per (64-query tile, head
//       pair, image), eight warps as 2 heads x 4 warps of 16 rows, each
//       running B6's online softmax (mma.sync bf16) for its head over K/V
//       tiles of the pair's 128 columns that the block stages once. The
//       fp32 (64, 128) output is staged in the shared memory of the K/V
//       tiles, each row's amax is taken over the pair, and only the int8
//       codes aq (N*T, D) and one fp32 scale per (row, pair) leave it;
//   (c) the projection on the shared int8 GEMM tile: its K loop stops
//       every 128 bytes (one pair) and flushes the exact int32 sum into an
//       fp32 accumulator as (acc * sa[row, p]) * sp[col], in the TPU
//       kernel's order, because each pair has its own row scale. The TPU's
//       pair-minor grid axis with a VMEM accumulator becomes this loop
//       inside one block: blocks run in parallel, nothing carries over
//       between them, and no atomics reorder the sum.
// Unlike the TPU kernel, the bf16 qkv (44 MB written and read at the
// flagship, as B2 and B8 pay) and the int8 codes with their pair scales
// (7.4 MB + 0.2 MB) pass through device memory between the launches:
// keeping them on chip is the lead for a fused redesign.

#include "qkv_int8_gemm.cuh"

namespace {

namespace gemm = lseg::qkv_gemm;
using lseg::ld_u32;

// ---- (b) the pair interior ----
constexpr int HD = 64;            // head_dim (the kernel is specialised)
constexpr int PW = 2 * HD;        // columns of a head pair
constexpr int BQ = 64;            // query rows per block (4 warps x 16)
constexpr int BKV = 64;           // keys per tile
constexpr int LDK = PW + 8;       // K/V smem row stride in bf16 (272 bytes)
constexpr int LDO = PW + 4;       // fp32 output stage row stride
constexpr int PTHREADS = 256;     // 2 heads x 4 warps
constexpr int KV_BYTES = 2 * BKV * LDK * 2;
static_assert(BQ * LDO * 4 <= KV_BYTES, "output stage fits the K/V tiles");

__global__ void __launch_bounds__(PTHREADS) pair_attention_q8_kernel(
    const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ aq,
    float* __restrict__ sa, int T, int D, int valid_len, float scale) {
  __shared__ __align__(16) unsigned char smem[KV_BYTES];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LDK;
  float* Os = reinterpret_cast<float*>(smem);  // after the key loop

  const int pair = blockIdx.y;
  const int pairs = gridDim.y;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hh = warp / 4;    // head of the pair
  const int wig = warp % 4;   // warp in head group: rows wig*16 ..
  const int g = lane / 4;
  const int t4 = lane % 4;

  const long long row_stride = 3LL * D;
  const __nv_bfloat16* base =
      qkv + static_cast<long long>(img) * T * row_stride;
  const int q_col = pair * PW + hh * HD;
  const int lrow = wig * 16 + g;  // local rows lrow and lrow + 8
  const int q0 = blockIdx.x * BQ + lrow;
  const int rows[2] = {q0, q0 + 8};

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = q_col + kk * 16 + 2 * t4 + 8 * half;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[kk][2 * half + r] =
            rows[r] < T ? ld_u32(base + rows[r] * row_stride + c) : 0u;
      }
    }
  }

  const float neg_inf = -__int_as_float(0x7f800000);
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_run[2] = {neg_inf, neg_inf};
  float l_run[2] = {0.0f, 0.0f};

  for (int k0 = 0; k0 < valid_len; k0 += BKV) {
    // the pair's K and V columns of 64 keys, both heads at once
    for (int i = tid; i < BKV * (PW / 8); i += PTHREADS) {
      const int r = i / (PW / 8);
      const int cv = (i % (PW / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (key < valid_len) {
        const __nv_bfloat16* rp = base + key * row_stride + pair * PW + cv;
        kv = *reinterpret_cast<const uint4*>(rp + D);
        vv = *reinterpret_cast<const uint4*>(rp + 2 * D);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDK + cv) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDK + cv) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp =
            Ks + (nt * 8 + g) * LDK + hh * HD + kk * 16 + 2 * t4;
        lseg::mma_bf16_16816(s[nt], qa[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const float v = key < valid_len ? s[nt][e] * scale : neg_inf;
        s[nt][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
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
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_run[e / 2]);
        s[nt][e] = p;
        rs[e / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          lseg::pack_f32(s[2 * kk][0], s[2 * kk][1]),
          lseg::pack_f32(s[2 * kk][2], s[2 * kk][3]),
          lseg::pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          lseg::pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vp =
            Vs + (kk * 16 + 2 * t4) * LDK + hh * HD + dt * 8 + g;
        const uint32_t b0 = lseg::pack_bf16(vp[0], vp[LDK]);
        const uint32_t b1 = lseg::pack_bf16(vp[8 * LDK], vp[9 * LDK]);
        lseg::mma_bf16_16816(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // the last one frees the K/V tiles for Os
  }

  // l over the 4 threads of each row; o / l in fp32 into the stage
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    float* op = Os + (lrow + 8 * r) * LDO + hh * HD + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      op[dt * 8] = __fdiv_rn(o[dt][2 * r], l_run[r]);
      op[dt * 8 + 1] = __fdiv_rn(o[dt][2 * r + 1], l_run[r]);
    }
  }
  __syncthreads();

  // per-row int8 quantize over the pair's 128 columns: a warp per row,
  // four columns a lane
  for (int lr = warp; lr < BQ; lr += PTHREADS / 32) {
    const int row = blockIdx.x * BQ + lr;
    if (row >= T) break;  // rows grow with lr: the rest are past T too
    const float4 v = *reinterpret_cast<const float4*>(Os + lr * LDO +
                                                      lane * 4);
    const float amax = lseg::warp_max(
        fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    const long long grow = static_cast<long long>(img) * T + row;
    *reinterpret_cast<uint32_t*>(aq + grow * D + pair * PW + lane * 4) =
        lseg::pack_codes(v.x, v.y, v.z, v.w, sc);
    if (lane == 0) sa[grow * pairs + pair] = sc;
  }
}

// ---- (c) the projection of scaled pair partials + bias + residual ----
__global__ void __launch_bounds__(gemm::THREADS) pair_proj_kernel(
    const int8_t* __restrict__ aq, const float* __restrict__ sa,
    const int8_t* __restrict__ wp, const float* __restrict__ sp,
    const float* __restrict__ bp, const __nv_bfloat16* __restrict__ resid,
    __nv_bfloat16* __restrict__ out, int M, int D) {
  __shared__ __align__(16) int8_t As[gemm::BM * gemm::LD];
  __shared__ __align__(16) int8_t Bs[gemm::BN * gemm::LD];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * gemm::BM;
  const int n0 = blockIdx.x * gemm::BN;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;
  const int pairs = D / PW;

  float facc[4][4][4];
  for (int p = 0; p < pairs; ++p) {
    gemm::Acc acc;
    gemm::zero(acc);
    gemm::mainloop(aq, wp, M, D, m0, n0, p * PW, (p + 1) * PW, As, Bs, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + wn + nt * 8 + 2 * t4;
      const float sc0 = sp[c], sc1 = sp[c + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + wm + mt * 16 + g + 8 * half;
          const float sr = r < M ? sa[static_cast<long long>(r) * pairs + p]
                                 : 0.0f;
          const float p0 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sr), sc0);
          const float p1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), sr), sc1);
          float* f = &facc[mt][nt][2 * half];
          if (p == 0) {
            float2 res = make_float2(0.0f, 0.0f);
            if (r < M) {
              res = __bfloat1622float2(*reinterpret_cast<
                  const __nv_bfloat162*>(resid + static_cast<long long>(r) *
                                                     D + c));
            }
            f[0] = __fadd_rn(__fadd_rn(p0, bp[c]), res.x);
            f[1] = __fadd_rn(__fadd_rn(p1, bp[c + 1]), res.y);
          } else {
            f[0] = __fadd_rn(f[0], p0);
            f[1] = __fadd_rn(f[1], p1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        if (r >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(r) * D + c) =
            __floats2bfloat162_rn(facc[mt][nt][2 * half],
                                  facc[mt][nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// Launch the three-step chain on `stream`; returns the first non-zero
// cudaGetLastError() (0 on success). qkv (N*T, 3D) bf16, aq (N*T, D) int8
// and sa (N*T, D / 128) fp32 are scratch buffers allocated by the wrapper.
// Requires dim % 128 == 0, 1 <= valid_len <= t, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_flash_attention_qkvp_fused(
    const void* xq, const void* sx, const void* wq, const void* sw,
    const void* bias, const void* wp, const void* sp, const void* bp,
    const void* resid, void* qkv, void* aq, void* sa, void* out, int n,
    int t, int dim, int valid_len, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  int rc = gemm::launch(xq, sx, wq, sw, bias, qkv, rows, 3 * dim, dim, st);
  if (rc != 0) return rc;

  const dim3 agrid((t + BQ - 1) / BQ, dim / PW, n);
  pair_attention_q8_kernel<<<agrid, PTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<int8_t*>(aq),
      static_cast<float*>(sa), t, dim, valid_len, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  const dim3 pgrid(dim / gemm::BN, (rows + gemm::BM - 1) / gemm::BM);
  pair_proj_kernel<<<pgrid, gemm::THREADS, 0, st>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(sa),
      static_cast<const int8_t*>(wp), static_cast<const float*>(sp),
      static_cast<const float*>(bp),
      static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), rows, dim);
  return static_cast<int>(cudaGetLastError());
}
