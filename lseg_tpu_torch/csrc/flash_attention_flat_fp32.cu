// The fp32 mode of flash attention over the flat fused-qkv layout for
// Hopper (sm_90a), the route of an fp32 model (`train --dtype float32`):
// kernel B6 (the forward); its backward, B7's fp32 mode, is
// flash_attention_flat_bwd_fp32.cu.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_flat and
// _flash_flat_bwd_impl (Pallas TPU) for fp32 inputs. The TPU kernels take
// any qkv dtype; in fp32 `p.astype(v.dtype)` and the casts of pn and ds
// are no-ops, so every step below is fp32:
//   forward:  s = (q . k^T) * scale; P = exp(s - m); l = sum P;
//             O = (P . V) / l; lse = m + log(l)            (all fp32)
//   backward: pn = exp(s - lse); dv = pn^T . dO; dp = dO . v^T;
//             Dr = rowsum(dO * O); ds = pn * (dp - Dr);
//             dq = (ds . k) * scale; dk = (ds^T . q) * scale (all fp32)
// Keys at or past `valid_len` are masked. The forward's online softmax
// rescales by the running row maximum (the TPU kernel takes the maximum of
// the whole row), and the backward reads the forward's lse instead of
// recomputing the row statistics: both differ from the reference at fp32
// rounding.
//
// What bounds it on the card: the products. At the flagship (8, 901,
// 3072) with 16 heads the forward is 2 * 2*T*T*64 FLOP per head, 26.6
// GFLOP: 0.397 ms of fp32 FMAs at 67 TFLOP/s, or 0.161 ms as split-TF32
// tensor-core products (tf32x3.cuh: three TF32 products of each operand's
// hi and lo keep ~21 bits of each, where one TF32 product would round the
// operands to 10 bits and miss the gate); inputs are 89 MB (0.03 ms).
//
// Design: split TF32 on mma.sync m16n8k8, B7's fp32 engine in the forward
// direction (flash_tf32x3.cuh). tf32 wgmma reads only K-major operands,
// and V (keys x head_dim) is MN-major for P . V: wgmma would need V's
// split transposed into scratch first, mma.sync reads the fragments of
// either orientation from the staged tile. One 128-thread block per
// (64-query tile, head, image), two blocks an SM (197 registers a thread,
// no spills; at three blocks, 168 registers spilled and ran no faster);
// warp w owns query rows 16w..16w+15 against all 64 keys of a tile. Q's
// A fragments are split once into hi and lo registers (64 a thread). Key and value tiles of 64 come by cp.async
// into a two-stage ring of padded tiles (68 floats a row), the next
// tile's copies in flight under this tile's products. Per key tile:
//   S = Q . K^T by mma3 into registers (8 column tiles of 8 keys);
//   the online softmax in registers: each row's maximum over its quad by
//     two shuffles, P = 2^(s * scale * log2 e - m) by the ex2.approx
//     instruction (m kept in the base-2 domain), the row sums kept per
//     thread and added over the quad once at the end;
//   O = O * alpha + P . V: P stays in registers, split again, and feeds
//     the A fragments through the C -> A column permutation (acc_pb), V's
//     rows read to match.
// lse = (m + log2 l) * ln 2 out, for B7. The exponent: ex2.approx of the
// prescaled score; expf of the scaled score (`python -m
// lseg_tpu_torch.engine.variant_tree b6_fp32_expf`) also passes the
// gate and runs 7% slower on an H100 (PERF.md).
//
// The tensor cores' fp32 accumulation truncates (tf32x3.cuh). A score is a
// fresh sum of 8 k-steps x 3 products = 24 truncating adds; O takes 24 a
// key tile, rescaled by alpha (a round-to-nearest multiply) every tile,
// so 360 over T = 901. A numpy emulation of this arithmetic
// (`tests/test_torch_flash_bwd.py::test_b6_fp32_kernel_arithmetic_
// emulated`) put the worst O within 8% of the gate (2e-5 + 1e-4 |O|) at
// (901, 64) with randn inputs, folding every tile's P . V into O with
// round-to-nearest adds within 3%: the truncation is inside the gate, so
// O accumulates in place without a second accumulator. Nothing is summed
// with atomics, so the result is deterministic.

#include "flash_tf32x3.cuh"

namespace {

namespace t3 = lseg::tf32x3;
using namespace lseg::flash_tf32x3;

constexpr int THREADS = 128;  // 4 warps of 16 query rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {
  float k[2][TILE_FLOATS];  // k[1] holds Q until its fragments are read
  float v[2][TILE_FLOATS];
};

__global__ void __launch_bounds__(THREADS, 2) flash_flat_fp32_kernel(
    const float* __restrict__ qkv, float* __restrict__ out,
    float* __restrict__ lse, int T, int D, int valid_len, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = qkv + static_cast<long long>(img) * T * ld;
  const int n_kt = (valid_len + BT - 1) / BT;
  const float sc = scale * kLog2e;  // scores in the base-2 domain

  stage<THREADS>(sm.k[1], base, ld, head * HD, q0, T);
  stage<THREADS>(sm.k[0], base, ld, D + head * HD, 0, T);
  stage<THREADS>(sm.v[0], base, ld, 2 * D + head * HD, 0, T);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  t3::Frag<4> qf[HD / 8];  // Q's A fragments, split once
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* pa = sm.k[1] + (r0 + g) * LD + kk * 8 + t;
    qf[kk].set(0, pa[0]);
    qf[kk].set(1, pa[8 * LD]);
    qf[kk].set(2, pa[4]);
    qf[kk].set(3, pa[8 * LD + 4]);
  }
  __syncthreads();  // k[1] is restaged below

  // rows g and g + 8 of the warp's 16: h = e / 2 of a C-layout element
  float m_run[2] = {-pos_inf(), -pos_inf()}, l_part[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1, k0 = it * BT;
    if (it + 1 < n_kt) {  // the next key tile, in flight under this one
      stage<THREADS>(sm.k[st ^ 1], base, ld, D + head * HD, k0 + BT, T);
      stage<THREADS>(sm.v[st ^ 1], base, ld, 2 * D + head * HD, k0 + BT, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* pb = sm.k[st] + (8 * j + g) * LD + kk * 8 + t;
        t3::Frag<2> fb;
        fb.set(0, pb[0]);
        fb.set(1, pb[4]);
        t3::mma3(s[j], qf[kk], fb);
      }
    }
    const bool ragged = k0 + BT > valid_len;
    float mx[2] = {-pos_inf(), -pos_inf()};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sc;
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= valid_len)
          x = -pos_inf();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: key 0 is valid
      alpha[h] = lseg::exp2_approx(m_run[h] - m_new);  // 0 on the first tile
      m_run[h] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lseg::exp2_approx(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_part[h] = l_part[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    acc_pb(o, s, sm.v[st], 0, g, t);
    __syncthreads();  // this stage is restaged next tile
  }

  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l_part[h] + __shfl_xor_sync(0xffffffffu, l_part[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* ob = out + static_cast<long long>(img) * T * D + head * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= T) continue;
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(img) * H + head) * T + row] =
          (m_run[h] + log2f(l[h])) * kLn2;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(row) * D +
                                 8 * n + 2 * t) =
          make_float2(o[n][2 * h] / l[h], o[n][2 * h + 1] / l[h]);
  }
}

}  // namespace

// Launch on `stream`; returns 0 or a CUDA error code. `lse` may be null.
// Requires D % 64 == 0, 1 <= valid_len <= T, 16-byte aligned qkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat_fp32(const void* qkv, void* out,
                                              void* lse, int n, int t,
                                              int dim, int valid_len,
                                              float scale, void* stream) {
  static const int attr =
      lseg::wg::allow_smem(flash_flat_fp32_kernel, sizeof(FwdSmem));
  if (attr != 0) return attr;
  const dim3 grid((t + BT - 1) / BT, dim / HD, n);
  flash_flat_fp32_kernel<<<grid, THREADS, sizeof(FwdSmem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out),
      static_cast<float*>(lse), t, dim, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}
