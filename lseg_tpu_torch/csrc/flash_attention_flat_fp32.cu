// The fp32 mode of flash attention over the flat fused-qkv layout for
// Hopper (sm_90a), the route of an fp32 model (`train --dtype float32`):
// kernel B6 (the forward); its backward, B7's fp32 mode, is
// flash_attention_flat_bwd_fp32.cu.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_flat and
// _flash_flat_bwd_impl (Pallas TPU) for fp32 inputs. The TPU kernels take
// any qkv dtype; in fp32 `p.astype(v.dtype)` and the casts of pn and ds
// are no-ops, so every step below is fp32 and no operand is rounded to
// bf16 or TF32:
//   forward:  s = (q . k^T) * scale; P = exp(s - m); l = sum P;
//             O = (P . V) / l; lse = m + log(l)            (all fp32)
//   backward: pn = exp(s - lse); dv = pn^T . dO; dp = dO . v^T;
//             Dr = rowsum(dO * O); ds = pn * (dp - Dr);
//             dq = (ds . k) * scale; dk = (ds^T . q) * scale (all fp32)
// Keys at or past `valid_len` are masked. The forward's online softmax
// rescales by the running row maximum (the TPU kernel takes the maximum of
// the whole row), and the backward reads the forward's lse instead of
// recomputing the row statistics: both differ from the reference at fp32
// rounding. Exponentials are expf (full precision).
//
// What bounds it on the card: the fp32 FMA units (67 TFLOP/s without
// tensor cores; TF32 would round the operands to 10 mantissa bits). At
// the flagship (8, 901, 3072) with 16 heads the forward is 2 * 2*T*T*64
// FLOP per head, 26.6 GFLOP (0.40 ms), the backward's least work five
// such products, 66.5 GFLOP (0.99 ms); inputs are 89 MB (0.03 ms).
//
// Design, a simple SIMT kernel: one 256-thread block per (64-row tile,
// head, image); tiles are staged from device memory into shared memory
// and each thread of a 16 x 16 grid holds a 4 x 4 tile of every product
// (flash_fp32.cuh).
//   forward: per key tile, S = Q.K^T into shared memory, the row
//     statistics by 4 threads a row, O = O * alpha + P.V in registers;
//   backward pass 1 (one block per query tile): Dr, then per key tile S
//     and dP, ds into shared memory, dQ += ds.K;
//   backward pass 2 (one block per key tile): per query tile S^T and
//     dP^T, pn^T and ds^T into shared memory, dV += pn^T.dO and
//     dK += ds^T.Q.
// Nothing is summed with atomics, so the result is deterministic. Not
// yet: asynchronous staging, register-blocked products above 4 x 4.

#include "flash_fp32.cuh"

namespace {

using namespace lseg::flash_fp32;

// ---- forward ----------------------------------------------------------------

struct FwdSmem {
  float q[TILE_FLOATS];
  float k[TILE_FLOATS];
  float v[TILE_FLOATS];
  float p[TILE_FLOATS];
  float alpha[BT];
  float l[BT];
};

__global__ void __launch_bounds__(THREADS) flash_flat_fp32_kernel(
    const float* __restrict__ qkv, float* __restrict__ out,
    float* __restrict__ lse, int T, int D, int valid_len, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = qkv + static_cast<long long>(img) * T * ld;
  const int n_kt = (valid_len + BT - 1) / BT;

  stage(sm.q, base, ld, head * HD, q0, T);
  // row statistics: 4 threads a row, 16 columns each
  const int srow = tid / 4, spart = tid % 4;
  float m_run = -pos_inf(), l_run = 0.0f;
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BT;
    stage(sm.k, base, ld, D + head * HD, k0, T);
    stage(sm.v, base, ld, 2 * D + head * HD, k0, T);
    __syncthreads();
    float s[4][4];
    dot_abt(s, sm.q, sm.k, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        sm.p[(ty + 16 * i) * LD + tx + 16 * j] =
            key < valid_len ? s[i][j] * scale : -pos_inf();
      }
    __syncthreads();
    {
      float* pr = sm.p + srow * LD + spart * 16;
      float mx = -pos_inf();
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);  // finite: key k0 is valid
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = expf(pr[c] - m_new);
        pr[c] = e;
        rs += e;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run = l_run * alpha + rs;
      m_run = m_new;
      if (spart == 0) sm.alpha[srow] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sm.alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= a;
    }
    acc_pb(o, sm.p, sm.v, ty, tx);
    __syncthreads();  // k, v and p are restaged next tile
  }
  if (spart == 0) {
    sm.l[srow] = l_run;
    if (lse != nullptr && q0 + srow < T)
      lse[(static_cast<long long>(img) * H + head) * T + q0 + srow] =
          m_run + logf(l_run);
  }
  __syncthreads();
  float* ob = out + static_cast<long long>(img) * T * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= T) continue;
    const float l = sm.l[r];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[static_cast<long long>(q0 + r) * D + head * HD + tx + 16 * j] =
          o[i][j] / l;
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

