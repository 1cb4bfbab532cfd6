// The flat flash-attention interior shared by kernels B6
// (flash_attention_flat.cu), B8 (flash_attention_qkv_fused.cu) and B9
// (flash_attention_ln_qkv_fused.cu).
//
// Input: qkv (N, T, 3D) bf16; head h reads q, k and v at column offsets
// h*64, D + h*64 and 2D + h*64 of each row. Output: flat (N, T, D) bf16,
// head h at columns h*64. Keys at or past `valid_len` are masked out of
// the softmax.
//
// Rounding points follow the TPU kernels (pallas_attention.py:47-64 and
// `_pair_softmax_attention`): scores q.k accumulate in fp32 and are
// multiplied by `scale` in fp32; P = exp(s - m) in fp32 is summed in fp32
// into l; P is cast to bf16 for P.V, which accumulates in fp32; the output
// is divided by l at the end and cast to bf16. One difference: the online
// softmax rounds P relative to the running row maximum (rescaling the
// accumulator when it grows), where the TPU kernels use the maximum of the
// whole row.
//
// Design: no transposes and no (T, T) scores in device memory. One
// 128-thread block per (q tile of 64 rows, head, image); each warp owns 16
// query rows, keeps its q fragments and its 16 x 64 fp32 output
// accumulator in registers, and walks the key tiles of 64 with an online
// softmax. K and V tiles are staged in shared memory with 16-byte loads;
// q.k^T and P.V run as bf16 mma.sync m16n8k16 with fp32 accumulators. The
// score fragment's register layout equals the A-operand layout of the next
// mma, so P never leaves registers. Any T works: the ragged last q tile
// and key tile are zero-filled and masked.

#pragma once

#include "lseg_common.cuh"

namespace lseg {
namespace {
namespace flash_flat {

constexpr int HD = 64;        // head_dim (the kernel is specialised)
constexpr int BQ = 64;        // query rows per block (4 warps x 16)
constexpr int BKV = 64;       // keys per tile
constexpr int LDS = HD + 8;   // smem row stride in bf16 (144 bytes)
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) flash_flat_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
    int T, int D, int valid_len, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LDS];

  const int head = blockIdx.y;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // mma group: rows g and g + 8
  const int t4 = lane % 4;  // thread in group: columns 2*t4, 2*t4 + 1

  const long long row_stride = 3LL * D;
  const __nv_bfloat16* base = qkv + static_cast<long long>(img) * T *
                                        row_stride;
  const int q_col = head * HD;
  const int k_col = D + head * HD;
  const int v_col = 2 * D + head * HD;
  const int q0 = blockIdx.x * BQ + warp * 16;
  const int rows[2] = {q0 + g, q0 + g + 8};

  // q fragments (A operand, 16 rows x 64 dims = 4 k-steps of 16)
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
  float l_run[2] = {0.0f, 0.0f};  // per-thread partial sums of P

  for (int k0 = 0; k0 < valid_len; k0 += BKV) {
    // stage K and V tiles (keys past valid_len zero-filled: masked rows
    // of V must be finite, P there is exactly 0)
    for (int i = tid; i < BKV * (HD / 8); i += THREADS) {
      const int r = i / (HD / 8);
      const int cv = (i % (HD / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (key < valid_len) {
        const __nv_bfloat16* rp = base + key * row_stride;
        kv = *reinterpret_cast<const uint4*>(rp + k_col + cv);
        vv = *reinterpret_cast<const uint4*>(rp + v_col + cv);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + cv) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDS + cv) = vv;
    }
    __syncthreads();

    // s = q . k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDS + kk * 16 + 2 * t4;
        mma_bf16_16816(s[nt], qa[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // fp32 scale, key mask, running row max
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

    // P = exp(s - m) in fp32; l and the accumulator rescale
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

    // o += bf16(P) . V: the score C-fragments are the A-fragments here
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t4) * LDS + dt * 8 + g;
        const uint32_t b0 = pack_bf16(vp[0], vp[LDS]);
        const uint32_t b1 = pack_bf16(vp[8 * LDS], vp[9 * LDS]);
        mma_bf16_16816(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  // l over the 4 threads of each row, divide, cast, store flat
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (rows[r] >= T) continue;
    __nv_bfloat16* op = out + (static_cast<long long>(img) * T + rows[r]) * D +
                        head * HD + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(op + dt * 8) = __floats2bfloat162_rn(
          o[dt][2 * r] / l_run[r], o[dt][2 * r + 1] / l_run[r]);
    }
  }
}

// Launch on `st`; returns cudaGetLastError() (0 on success). Requires
// D % 64 == 0, 1 <= valid_len <= T, 16-byte aligned qkv.
inline int launch(const void* qkv, void* out, int n, int t, int dim,
                  int valid_len, float scale, cudaStream_t st) {
  const dim3 grid((t + BQ - 1) / BQ, dim / HD, n);
  flash_flat_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), t, dim, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_flat
}  // namespace
}  // namespace lseg
